"""The port's own spans (``utils/profiling.py::span``) on the CPU: nothing
recorded and no profiler range entered without a profiler; under the
benchmark's low-level profiler start and under ``torch.profiler.profile``,
the names, nesting and shared root of every registrar call and training
step; the int8 convs' spans; each span's interval around its event in a
trace of every scope, and no event in the benchmark's trace of the user
scope; the ring's count of what it drops. Small shapes: 32x32x48, enc/dec 8
(64 for int8), float32."""

import numpy as np
import pytest
import torch
from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
from torch._C._profiler import (ProfilerActivity, ProfilerConfig, ProfilerState, RecordScope,
                                _ExperimentalConfig)

from multimodal_registration_torch.infer.config import InferenceConfig
from multimodal_registration_torch.infer.register import Registrar, vxm_config_from
from multimodal_registration_torch.models.vxm_dense import VxmDense
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.train.trainer import Trainer
from multimodal_registration_torch.utils import profiling

SHAPE = (32, 32, 48)
WIDTHS = {"enc": [8] * 4, "dec": [8] * 6, "compute_dtype": "float32"}
FORWARD = {"vxm.unet", "vxm.flow_head", "vxm.tail", "vxm.integrate", "vxm.fullres", "vxm.warp"}
# the loss reads no moved image; with grad_res 1 Grad reads the full-res field
TRAIN_FORWARD = FORWARD - {"vxm.warp"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def registrar(**cfg) -> Registrar:
    icfg = InferenceConfig(**{**WIDTHS, **cfg})
    torch.manual_seed(0)
    params = VxmDense(vxm_config_from(icfg)).state_dict()
    params["flow.weight"].normal_(0.0, 0.05)
    return Registrar(icfg, params, max_batch=2, device="cpu")


def pair(batch=1):
    g = torch.Generator().manual_seed(3)
    return torch.rand((batch, *SHAPE), generator=g), torch.rand((batch, *SHAPE), generator=g)


@pytest.fixture(scope="module")
def trainer():
    cfg = TrainConfig.from_dict({
        **WIDTHS, "in_shape": list(SHAPE), "num_labels": 4, "batch_size": 1, "im_scales": [4, 8],
        "def_scales": [4], "vel_res": 4.0, "bias_res": 8.0, "grad_clip_norm": 1.0,
        "num_devices": 1, "verbose": 0})
    return Trainer(cfg, device="cpu")


def maps():
    g = torch.Generator().manual_seed(5)
    return (torch.randint(0, 4, (1, *SHAPE), generator=g, dtype=torch.uint8),
            torch.randint(0, 4, (1, *SHAPE), generator=g, dtype=torch.uint8))


def harness_start(block):
    """``block()`` under the profiler as ``perfbench/trace.py::profiled``
    starts it (Kineto, the user scope only); its events."""
    acts = {ProfilerActivity.CPU}
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         _ExperimentalConfig())
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    try:
        block()
    finally:
        result = _disable_profiler()
    return result.events()


def profile_api(block):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        block()
    return prof.profiler.kineto_results.events()


def recorded(start, block):
    """The span records that ``block`` adds, and the profiler's events."""
    before = {r[3] for r in profiling.spans()}
    events = start(block)
    return [r for r in profiling.spans() if r[3] not in before], events


def tree(recs) -> dict:
    """``{root name: {(child name, parent name)}}`` of each root."""
    by_id = {r[3]: r for r in recs}
    out = {}
    for r in recs:
        root = by_id[r[5]]
        parent = by_id[r[4]][0] if r[4] else None
        out.setdefault((root[0], root[3]), set()).add((r[0], parent))
    return out


def test_without_a_profiler_nothing_is_recorded(monkeypatch, trainer):
    def boom(*a, **k):
        raise AssertionError("a profiler range entered without a profiler")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", boom)
    assert profiling.span("vxm.unet") is profiling.span("train.step")
    before = profiling.spans()
    reg = registrar()
    mov, fx = pair()
    reg.predict_tensors(mov, fx)
    reg.predict(mov.numpy(), fx.numpy())
    trainer.train_step(trainer.generator(1), *maps())
    assert profiling.spans() == before


@pytest.mark.parametrize("start", [harness_start, profile_api], ids=["harness", "profile"])
def test_registrar_spans_nest_under_one_root_a_call(start):
    reg = registrar(quantize="int8")  # no scales: the first chunk calibrates
    mov, fx = pair()
    recs, _ = recorded(start, lambda: (reg.predict_tensors(mov, fx),
                                       reg.predict(mov.numpy(), fx.numpy())))
    roots = tree(recs)
    assert [name for name, _ in roots] == ["registrar.predict_tensors", "registrar.predict"]
    first, second = roots.values()
    fwd = {(n, "registrar.predict_tensors") for n in ("vxm.unet", "vxm.flow_head", "vxm.tail")}
    tail = {(n, "vxm.tail") for n in FORWARD - {"vxm.unet", "vxm.flow_head", "vxm.tail"}}
    # the calibration's forward nests under registrar.calibrate, on the first call only
    calibration = {("registrar.calibrate", "registrar.predict_tensors"),
                   ("vxm.unet", "registrar.calibrate"), ("vxm.flow_head", "registrar.calibrate"),
                   ("vxm.tail", "registrar.calibrate")}
    own = {("registrar.predict_tensors", None), ("registrar.to_device",
                                                 "registrar.predict_tensors")}
    assert first == own | fwd | tail | calibration
    assert second == ({("registrar.predict", None), ("registrar.to_host", "registrar.predict"),
                       ("registrar.predict_tensors", "registrar.predict"),
                       ("registrar.to_device", "registrar.predict_tensors")} | fwd | tail)
    assert {r[6] for r in recs} == {recs[0][6]}  # one thread


def test_int8_spans_once_a_quantizable_block_nested_in_the_unet():
    cfg = vxm_config_from(InferenceConfig(**{**WIDTHS, "enc": [64] * 4, "dec": [64] * 6,
                                             "quantize": "int8"}))
    torch.manual_seed(0)
    model = VxmDense(cfg).eval()
    model.set_quant_scales({k: 4.0 for k in model.quant_blocks()})
    mov, fx = pair()

    def forward():
        with torch.inference_mode():
            model(mov[..., None], fx[..., None])

    before = profiling.spans()
    forward()
    assert profiling.spans() == before
    recs, _ = recorded(profile_api, forward)
    by_id = {r[3]: r for r in recs}
    assert len(model.quant_blocks()) == 9
    for name in ("int8.quantize", "int8.conv"):
        mine = [r for r in recs if r[0] == name]
        assert len(mine) == 9, name
        assert {by_id[r[4]][0] for r in mine} == {"vxm.unet"}, name


def test_rescale_span_opens_only_where_the_tail_rescales():
    mov, fx = pair()
    plain, _ = recorded(profile_api, lambda: registrar().predict_tensors(mov, fx))
    smooth, _ = recorded(profile_api,
                         lambda: registrar(svf_smooth_sigma=1.0).predict_tensors(mov, fx))
    assert "vxm.rescale" not in {r[0] for r in plain}
    assert [r[0] for r in smooth].count("vxm.rescale") == 1


@pytest.mark.parametrize("start", [harness_start, profile_api], ids=["harness", "profile"])
def test_training_spans_nest_under_one_root_a_step(start, trainer):
    src, trg = maps()
    recs, _ = recorded(start, lambda: (trainer.train_step(trainer.generator(1), src, trg),
                                       trainer.val_step(trainer.generator(2), src, trg)))
    roots = tree(recs)
    assert [name for name, _ in roots] == ["train.step", "train.val"]
    step, val = roots.values()
    forward = ({("vxm.unet", "train.loss"), ("vxm.flow_head", "train.loss"),
                ("vxm.tail", "train.loss")}
               | {(n, "vxm.tail") for n in TRAIN_FORWARD - {"vxm.unet", "vxm.flow_head",
                                                            "vxm.tail"}})
    assert step == ({("train.step", None)} | forward
                    | {(n, "train.step") for n in ("train.draw", "train.build", "train.loss",
                                                   "train.backward", "train.clip",
                                                   "train.adam")})
    assert val == ({("train.val", None)} | forward
                   | {(n, "train.val") for n in ("train.draw", "train.build", "train.loss")})


def test_each_span_contains_its_profiler_event():
    reg = registrar()
    mov, fx = pair()
    recs, events = recorded(profile_api, lambda: [reg.predict(mov, fx) for _ in range(2)])
    names = {r[0] for r in recs}
    spans = {n: sorted((r[1], r[2]) for r in recs if r[0] == n) for n in names}
    evs = {n: sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                     if e.name() == n and e.device_type() == torch.autograd.DeviceType.CPU)
           for n in names}
    assert names == FORWARD | {"registrar.predict", "registrar.predict_tensors",
                               "registrar.to_device", "registrar.to_host"}
    for n in names:
        assert len(spans[n]) == len(evs[n]) == 2, n
        for (s, e), (es, ee) in zip(spans[n], evs[n]):
            assert s <= es and ee <= e, n
            assert es - s < 1_000_000 and e - ee < 1_000_000, n


def test_the_user_scope_trace_holds_no_span_event():
    """The benchmark's profiler records the user scope only: the spans are in
    the ring, and not among its events, so none is projected onto the
    device's timeline as an operation."""
    reg = registrar()
    mov, fx = pair()
    recs, events = recorded(harness_start, lambda: reg.predict(mov, fx))
    assert {r[0] for r in recs} >= FORWARD
    assert not {e.name() for e in events} & {r[0] for r in recs}


def test_a_span_left_by_an_exception_is_recorded_and_closed():
    def fail():
        with profiling.span("vxm.tail"):
            raise KeyError("x")

    def block():
        with pytest.raises(KeyError):
            fail()
        with profiling.span("vxm.warp"):
            pass

    recs, _ = recorded(profile_api, block)
    assert [(r[0], r[4]) for r in recs] == [("vxm.tail", 0), ("vxm.warp", 0)]


def test_the_ring_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "_RING", profiling._Ring(4))

    def block():
        for i in range(6):
            with profiling.span(f"s{i}"):
                pass

    profile_api(block)
    assert profiling.dropped() == 2
    assert [r[0] for r in profiling.spans()] == ["s2", "s3", "s4", "s5"]
    assert np.all(np.diff([r[3] for r in profiling.spans()]) > 0)
