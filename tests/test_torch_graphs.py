"""The inference forward as CUDA graphs (``utils/graphs.py``), replayed
layer by layer from ``Registrar.predict_tensors``.

On the CPU: no graph engages off the card, with ``impl="plain"``, while the
int8 scales calibrate or are missing, under grad or outside
``predict_tensors``, and ``graph_counts["eager"]`` counts those forwards; the
key policy as a unit (first sighting eager, second capture, the bound
releases the key used least recently, a change of the scales or the
parameters drops every key, a failed capture stays eager); the span listener
that cuts a captured segment into graphs; the diverted launch counts of a
capture; the device constants; and ``rescale_field``'s vector factors against
the product by ``torch.tensor(f3)`` it replaced, bit for bit.

On the card (marker ``cuda``; they skip without one): replayed outputs equal
the eager first call of the same key bit for bit (a 64-wide pair, a 256-wide
pair at a reduced shape, a batch-4 tile chunk without moved images, an int8
pair with its scales set); an output kept by the caller survives later
replays; ``graph_counts`` and the launch counts per forward are as derived;
a replay under the benchmark's profiler gives each device operation to the
span of its layer. This file imports nothing of JAX:

    python -m pytest tests/test_torch_graphs.py -q --noconftest
"""

import gc
import weakref

import pytest
import torch

from multimodal_registration_torch import device as tdevice
from multimodal_registration_torch import kernels
from multimodal_registration_torch.infer.config import InferenceConfig
from multimodal_registration_torch.infer.register import Registrar
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.ops import resize
from multimodal_registration_torch.utils import graphs, profiling

from _torch_port import cuda_device  # noqa: F401

SMALL = dict(enc=[4] * 4, dec=[4] * 6, compute_dtype="float32")


def registrar(arch=SMALL, device="cpu", head_std=0.1, seed=0, **kw):
    """A registrar with the model's own initial weights, the head widened so
    that the field moves voxels."""
    cfg = InferenceConfig(**arch)
    torch.manual_seed(seed)
    model = VxmDense(VxmConfig(enc=tuple(arch["enc"]), dec=tuple(arch["dec"]),
                               compute_dtype=arch["compute_dtype"],
                               quantize=arch.get("quantize", "")))
    with torch.no_grad():
        model.flow.weight.normal_(0.0, head_std)
    return Registrar(cfg, model.state_dict(), device=device, **kw)


def pair(shape, batch=1, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((batch, *shape), generator=g).to(device),
            torch.rand((batch, *shape), generator=g).to(device))


# ---- CPU: where no graph engages -------------------------------------------------

def test_no_graph_on_the_cpu_and_each_forward_counts_eager():
    reg = registrar(max_batch=2)
    mov, fx = pair((16, 16, 32), batch=5)
    first = reg.predict_tensors(mov, fx)
    again = reg.predict_tensors(mov, fx)
    assert reg.graph_counts == {"captures": 0, "replays": 0, "eager": 6}  # 3 chunks a call
    assert reg.graphs.captured() == 0
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["plain", "calibrating", "missing_scales", "no_inference_mode"])
def test_no_key_where_graphs_do_not_apply(case):
    """The key is None (the forward runs eager) before any question to the
    card, so a CPU registrar told it is on the card shows each rule."""
    arch = dict(SMALL, enc=[64] * 4, dec=[64] * 6, quantize="int8") \
        if case in ("calibrating", "missing_scales") else SMALL
    reg = registrar(arch, impl="plain" if case == "plain" else None)
    if case == "calibrating":
        reg.model.set_quant_scales({k: 1.0 for k in reg.model.quant_blocks()})
        reg.model.quant_calibrate = True
    reg.device = torch.device("cuda")
    m = torch.zeros((1, 16, 16, 16, 1))
    if case == "no_inference_mode":
        assert reg._graph_key(m, m, True) is None
    else:
        with torch.inference_mode():
            assert reg._graph_key(m, m, True) is None


def test_no_state_for_parameters_made_under_inference_mode():
    """Their in-place writes count no version, so no graph could see them
    change (``ShardedRegistrar``'s fallback registrar is made so)."""
    assert registrar()._graph_state() is not None
    with torch.inference_mode():
        reg = registrar()
    assert reg._graph_state() is None


def test_no_graph_under_grad_or_outside_predict_tensors():
    """A direct call of the model, under grad or not, runs every segment as
    it is: no forward is captured or replayed on the thread."""
    reg = registrar()
    seen = []
    reg.model.unet.register_forward_hook(lambda *_: seen.append(graphs._run()))
    mov, fx = pair((16, 16, 32))
    out = reg.model(mov[..., None].requires_grad_(), fx[..., None])
    out["warp"].sum().backward()
    with torch.no_grad():
        reg.model(mov[..., None], fx[..., None])
    assert seen == [None, None]
    assert reg.graph_counts == {"captures": 0, "replays": 0, "eager": 0}


def test_segments_and_static_inputs_pass_through_without_a_run():
    x, y = torch.rand(3, 2), torch.rand(3, 2)
    assert graphs.segment("any", lambda a, b=0: a + b, x, b=y).equal(x + y)
    assert graphs.static_copy("moving", x) is x
    assert graphs.static_cat("x", [x, y], -1).equal(torch.cat([x, y], -1))


def test_a_segments_signature_reads_tensors_by_address():
    x = torch.zeros(4)
    a = graphs._signature((x, 5, None), {"impl": None, "steps": 3})
    assert a == (x.data_ptr(), 5, None, "impl", None, "steps", 3)
    assert a == graphs._signature((x.view(2, 2), 5, None), {"steps": 3, "impl": None})
    assert a != graphs._signature((x.clone(), 5, None), {"impl": None, "steps": 3})


# ---- CPU: the key policy ------------------------------------------------------------

class Captured:
    """Stands for a key's graphs in the policy's unit tests."""


def test_policy_first_sighting_eager_second_capture_then_replay():
    fg = graphs.ForwardGraphs("cpu")
    assert fg.action("a", 0) == "eager"
    assert fg.action("a", 0) == "capture"
    fg.settle("a", Captured())
    assert [fg.action("a", 0) for _ in range(3)] == ["replay"] * 3
    assert fg.counts == {"captures": 1, "replays": 0, "eager": 0}


def test_policy_a_failed_capture_stays_eager():
    fg = graphs.ForwardGraphs("cpu")
    fg.action("a", 0), fg.action("a", 0)
    fg.settle("a", None)
    assert [fg.action("a", 0) for _ in range(3)] == ["eager"] * 3
    assert fg.counts["eager"] == 1 and fg.counts["captures"] == 0


def test_policy_the_bound_releases_the_key_used_least_recently():
    fg = graphs.ForwardGraphs("cpu")
    held = {}
    for k in range(fg.MAX_KEYS):
        fg.action(k, 0), fg.action(k, 0)
        held[k] = Captured()
        fg.settle(k, held[k])
    gone = weakref.ref(held.pop(1))
    assert fg.action(0, 0) == "replay"  # 0 used again: 1 is now the oldest
    assert fg.action("new", 0) == "eager"  # a one-off key takes a place
    gc.collect()
    assert gone() is None  # 1's graphs released
    assert fg.action(1, 0) == "eager"  # seen anew
    assert fg.action(0, 0) == "replay" and fg.action(3, 0) == "replay"


@pytest.mark.parametrize("change", ["scales", "parameters"])
def test_policy_a_change_of_state_drops_every_key(change):
    reg = registrar()
    key, state = "k", reg._graph_state()
    reg.graphs.action(key, state), reg.graphs.action(key, state)
    reg.graphs.settle(key, Captured())
    assert reg.graphs.action(key, reg._graph_state()) == "replay"
    if change == "scales":
        reg.model.set_quant_scales(None)
    else:
        with torch.no_grad():
            reg.model.flow.bias.add_(0.0)  # an in-place write bumps the version
    assert reg._graph_state() != state
    assert reg.graphs.action(key, reg._graph_state()) == "eager"
    assert reg.graphs.captured() == 0


# ---- CPU: the capture's pieces, launches and constants --------------------------------

class Listener:
    def __init__(self):
        self.heard = []

    def enter(self, name):
        self.heard.append(("enter", name))

    def exit(self, name):
        self.heard.append(("exit", name))


def test_spans_tell_a_listener_without_a_profiler():
    lis = Listener()
    with profiling.listening(lis):
        with profiling.span("vxm.tail"):
            with profiling.span("vxm.warp"):
                pass
    with profiling.span("vxm.tail"):  # heard no more
        pass
    assert lis.heard == [("enter", "vxm.tail"), ("enter", "vxm.warp"), ("exit", "vxm.warp"),
                         ("exit", "vxm.tail")]
    assert profiling.span("vxm.tail") is profiling.span("vxm.unet")  # the shared no-op


def test_a_capture_diverts_launch_counts_and_a_replay_adds_them(monkeypatch):
    k = kernels.UP_CAT
    monkeypatch.setitem(k._fns, k.symbol, lambda *args: 0)  # a launcher that enqueues nothing
    kernels.reset_launch_counts()
    with kernels.diverted_launches() as counted:
        k.launch()
        k.launch()
    assert kernels.launch_counts()["up_cat"] == 0
    assert counted == {(k, "up_cat_launch"): 2}
    kernels.add_launches(counted)
    kernels.add_launches(counted)
    k.launch()
    assert kernels.launch_counts()["up_cat"] == 5
    assert kernels.entry_launch_counts() == {"up_cat_launch": 5}
    kernels.reset_launch_counts()


def test_device_constants_are_made_once_and_bounded(monkeypatch):
    monkeypatch.setattr(tdevice, "_CONSTANTS_MAX", 3)
    tdevice._CONSTANTS.clear()
    a = tdevice.constant((2.0, 1.5, 0.5), torch.float32, "cpu")
    assert a is tdevice.constant((2.0, 1.5, 0.5), torch.float32, torch.device("cpu"))
    assert a.equal(torch.tensor((2.0, 1.5, 0.5)))
    assert tdevice.constant((2.0, 1.5, 0.5), torch.bfloat16, "cpu") is not a
    for v in (1.0, 3.0):
        tdevice.constant(v, torch.float32, "cpu")
    assert len(tdevice._CONSTANTS) == 3
    assert (((2.0, 1.5, 0.5), torch.float32, torch.device("cpu")) not in tdevice._CONSTANTS)
    assert tdevice._CONSTANTS in graphs._HELD
    tdevice._CONSTANTS.clear()


def bits(x):
    return x.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64, torch.float16])
@pytest.mark.parametrize("f3", [(2.0, 2.0, 2.0), (1.6, 1.6, 1.6), (0.3, 0.3, 0.3),
                                (2, 2, 2), (2.0, 1.5, 0.7), (1.0 / 3, 2.0, 2.0)])
def test_vector_factors_multiply_as_the_tensor_of_the_factors(dtype, f3):
    out = (torch.randn((6, 5, 7, 3), generator=torch.Generator().manual_seed(3)) * 40).to(dtype)
    old = out * torch.tensor(f3, dtype=out.dtype, device=out.device)
    new = out * resize.vector_factors(f3, out)
    assert new.dtype == old.dtype
    assert torch.equal(bits(new), bits(old))
    assert isinstance(resize.vector_factors(f3, out), float) == (len(set(f3)) == 1)


@pytest.mark.parametrize("factor, shape, out_shape", [
    (2, (5, 4, 6), None), ((2.0, 2.0, 2.0), (4, 4, 4), (8, 8, 8)),
    ((1.5, 2.0, 0.5), (4, 6, 8), (6, 12, 4)), (0.5, (8, 6, 4), None)])
def test_rescale_field_is_the_product_it_was(factor, shape, out_shape):
    flow = torch.randn((*shape, 3), generator=torch.Generator().manual_seed(4)) * 5
    f3 = (factor,) * 3 if isinstance(factor, (int, float)) else factor
    want = resize.resize(flow, f3, out_shape=out_shape) * torch.tensor(f3, dtype=torch.float32)
    assert torch.equal(resize.rescale_field(flow, factor, out_shape=out_shape), want)


# ---- the card ---------------------------------------------------------------------------

W64 = dict(enc=[64] * 4, dec=[64] * 6, compute_dtype="bfloat16")
W256 = dict(enc=[256] * 4, dec=[256] * 6, compute_dtype="bfloat16")


def _clone(outs):
    return tuple(None if o is None else o.clone() for o in outs)


def _equal(a, b):
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def _through_graphs(reg, inputs, with_moved=True):
    """Predict ``inputs[0]`` three times (eager, capture, replay) and keeps a
    fourth, then the others (replays); returns the first three outputs and
    the others', and checks the counts as derived: one forward a call."""
    kernels.reset_launch_counts()
    outs = [_clone(reg.predict_tensors(*inputs[0], with_moved=with_moved)) for _ in range(3)]
    kept = reg.predict_tensors(*inputs[0], with_moved=with_moved)
    snapshot = _clone(kept)
    others = [_clone(reg.predict_tensors(*p, with_moved=with_moved)) for p in inputs[1:]]
    torch.cuda.synchronize()
    n = 4 + len(inputs) - 1
    assert reg.graph_counts == {"captures": 1, "eager": 1, "replays": n - 2}
    want = reg.model.kernel_launches(with_moved=with_moved)
    seen = {**kernels.launch_counts(), **kernels.entry_launch_counts()}
    assert seen == {k: n * v for k, v in want.items()}
    assert _equal(kept, snapshot)  # the replays on other inputs left it alone
    return outs, others


@pytest.mark.cuda
@pytest.mark.parametrize("arch, shape, kw", [
    (W64, (160, 160, 192), {}), (W256, (64, 64, 80), {}),
    (W64, (64, 64, 80), {"svf_smooth_sigma": 1.0})], ids=["w64", "w256", "w64_smoothed"])
def test_card_replays_equal_the_eager_forward_bit_for_bit(cuda_device, arch, shape, kw):
    """The smoothed SVF is the cascade's first model."""
    reg = registrar(arch, device=cuda_device, **kw)
    inputs = [pair(shape, seed=s, device=cuda_device) for s in range(3)]
    (eager, captured, replayed), others = _through_graphs(reg, inputs)
    assert _equal(eager, captured) and _equal(eager, replayed)
    for p, got in zip(inputs[1:], others):  # each against an eager first call
        assert _equal(got, _clone(registrar(arch, device=cuda_device, **kw).predict_tensors(*p)))


@pytest.mark.cuda
def test_card_a_tile_chunk_without_moved_images(cuda_device):
    reg = registrar(W256, device=cuda_device)
    inputs = [pair((80, 80, 96), batch=4, seed=s, device=cuda_device) for s in range(2)]
    (eager, captured, replayed), _ = _through_graphs(reg, inputs, with_moved=False)
    assert eager[0] is None and eager[1].shape == (4, 40, 40, 48, 3)
    assert _equal(eager, captured) and _equal(eager, replayed)


@pytest.mark.cuda
def test_card_an_int8_pair_once_its_scales_are_set(cuda_device):
    reg = registrar(dict(W256, quantize="int8"), device=cuda_device)
    inputs = [pair((64, 64, 80), seed=s, device=cuda_device) for s in range(3)]
    reg.predict_tensors(*inputs[2])  # calibrates on its chunk, then an eager forward
    assert reg.quant_scales is not None
    reg.graphs.clear()
    reg.graph_counts.update(captures=0, replays=0, eager=0)
    (eager, captured, replayed), _ = _through_graphs(reg, inputs)
    assert _equal(eager, captured) and _equal(eager, replayed)
    reg.model.set_quant_scales({k: 2 * v for k, v in reg.quant_scales.items()})
    changed = reg.predict_tensors(*inputs[0])  # the graphs dropped: eager, new scales
    assert reg.graphs.captured() == 0 and not _equal(changed, eager)


@pytest.mark.cuda
def test_card_a_replay_gives_each_operation_to_its_layers_span(cuda_device):
    """Under the benchmark's profiler a replayed forward's device operations
    carry the launches of their graphs, inside the same program spans as the
    eager forward's: the U-Net's, the head's and the tail's, K11's nine and
    K10's three."""
    from perfbench import program_spans as ps
    from perfbench import trace as tr

    reg = registrar(W64, device=cuda_device)
    mov, fx = pair((96, 96, 112), device=cuda_device)
    reg.predict_tensors(*pair((64, 64, 80), device=cuda_device))  # K1's weights prepared

    def traced():
        with tr.profiled() as events:
            with tr.record_function(tr.WINDOW):
                with tr.record_function("bench.call"):
                    reg.predict_tensors(mov, fx)
        return tr.parse(events(), 1, {})

    eager = traced()
    reg.predict_tensors(mov, fx)  # the capture
    replay = traced()
    assert reg.graph_counts == {"captures": 1, "replays": 1, "eager": 2}
    assert len(replay.under("call")) == len(eager.under("call")) + 1  # the moving image's copy
    for name, n in (("vxm.unet", None), ("vxm.flow_head", 1), ("vxm.tail", None),
                    ("unet.bias_lrelu", 9), ("unet.up_cat", 3), ("vxm.warp", 1)):
        counts = []
        for t in (eager, replay):
            iv = ps.intervals(t, name)
            ops = [op for op in t.ops
                   if any(s <= op[3] <= e for s, e in iv)] if iv else []
            counts.append(len(ops))
        assert counts[0] == counts[1] and counts[1] > 0 and n in (None, counts[1]), (name, counts)
