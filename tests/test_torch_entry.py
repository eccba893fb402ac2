"""The port's ``entry()`` (``multimodal_registration_torch/entry.py``) against
the JAX ``__graft_entry__.py::entry()``, on the CPU.

  * the model's configuration equals the JAX ``entry()``'s (read from its
    ``fn``'s closure), and so do the example inputs' shapes and dtypes;
  * ``example_args`` on ``device="cpu"``: the model's state dict (float32,
    the keys and shapes that ``params_from_jax`` makes of the JAX entry's
    parameters) and float32 zeros ``(1, 160, 160, 192, 1)``, all on the CPU;
  * at 16^3 on a random pair, the port's ``fn`` with ``params_from_jax`` of
    the JAX ``entry()``'s parameters against the JAX ``fn`` (jitted) on the
    same parameters: ``moved`` and ``warp`` within twice the JAX package's own
    bf16-against-float32 difference on the same inputs, the bf16 tolerance of
    ``tests/test_torch_model.py`` (every conv output is rounded to bf16 on both
    sides, so a last-bit difference of a sum flips a rounding by one bf16 ulp,
    which is the size of the effect bf16 itself has). Once with the entry's
    parameters as they are (a flow head of std 1e-5, fields of 1e-4 voxel),
    once with the flow head's kernel scaled on both sides so that the field
    is over half a voxel;
  * ``fn`` computes with the ``params`` it is given and leaves the model's own
    weights as they were;
  * ``entry()`` raises without a card unless ``device="cpu"``.

The JAX ``entry()`` draws its parameters with ``init_params(cfg, inshape=(32,
32, 32))``, op by op, which takes about 13 s on one core. The test runs it with
``init_params`` replaced by the same ``model.init`` of the same key compiled
whole by ``jax.jit`` at XLA's lowest optimisation level, on a dummy input of
16^3 (flax draws a parameter from its key and its module's path, not from the
input's size: at the default level the 16^3 and the 32^3 draws are equal,
exactly): the weights are within 4.5e-8 (float32 last bits of the truncated
normal) of the op-by-op draw, and both sides of every comparison get the same
ones. The JAX forwards are compiled at that level too.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_torch import entry as tentry
from multimodal_registration_torch.models.vxm_dense import VxmDense
from multimodal_registration_torch.models.weights import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = (1, 16, 16, 16, 1)
FLOW_SCALE = 3e4
# XLA's lowest optimisation level: each of the JAX side's compiles takes about
# a second on one core (the entry's initialisation 13 s at the default level)
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _compiled(f, *args):
    return jax.jit(f).lower(*args).compile(compiler_options=O0)


@pytest.fixture(scope="module")
def jax_entry():
    """``(fn, example_args, model, forwards)`` of the JAX ``entry()``;
    ``forwards`` is its ``fn`` and the float32 model's ``apply`` compiled at
    16^3."""
    from multimodal_registration_tpu.models import vxm_dense as jvd

    def init_params(cfg, inshape=(32, 32, 32), seed=0):
        dummy = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
        key = jax.random.PRNGKey(seed)
        return _compiled(jvd.VxmDense(cfg=cfg).init, key, dummy, dummy)(key, dummy, dummy)

    spec = importlib.util.spec_from_file_location("__graft_entry__",
                                                  os.path.join(ROOT, "__graft_entry__.py"))
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jvd, "init_params", init_params)
        fn, args = graft.entry()
    closure = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    model = closure["model"]
    f32 = jvd.VxmDense(cfg=dataclasses.replace(model.cfg, compute_dtype="float32",
                                               integrate_payload_dtype=""))
    x = jnp.zeros(SMALL, jnp.float32)
    forwards = (_compiled(fn, args[0], x, x), _compiled(f32.apply, args[0], x, x))
    return fn, args, model, forwards


def test_config_and_input_shapes_equal_the_jax_entrys(jax_entry):
    _, args, model, _ = jax_entry
    assert dataclasses.asdict(tentry.CFG) == dataclasses.asdict(model.cfg)
    assert tentry.SHAPE == args[1].shape == args[2].shape
    assert str(args[1].dtype) == "float32"


def test_example_args_on_the_cpu(jax_entry):
    fn, (params, moving, fixed) = tentry.entry("cpu")
    want = params_from_jax(jax_entry[1][0], tentry.CFG)
    assert list(params) == list(VxmDense(tentry.CFG, device="meta").state_dict())
    assert {k: v.shape for k, v in params.items()} == {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in params.values())
    for x in (moving, fixed):
        assert x.shape == tentry.SHAPE and x.dtype == torch.float32
        assert x.device.type == "cpu" and not x.any()


def _scaled(flat, scale):
    """The JAX parameter tree with the flow head's kernel times ``scale``."""
    p = {k: dict(v) for k, v in flat["params"].items()}
    p["flow"]["kernel"] = p["flow"]["kernel"] * scale
    return {"params": p}


@pytest.mark.parametrize("scale", [1.0, FLOW_SCALE], ids=["entry_params", "scaled_flow_head"])
def test_fn_matches_the_jax_fn_at_16_cubed(jax_entry, scale):
    _, jargs, _, (jfn, jf32) = jax_entry
    jparams = _scaled(jargs[0], scale)
    rng = np.random.default_rng(4)
    mov, fx = (rng.random(SMALL, np.float32) for _ in range(2))
    j16 = [np.asarray(a, np.float32) for a in jfn(jparams, jnp.asarray(mov), jnp.asarray(fx))]
    out = jf32(jparams, jnp.asarray(mov), jnp.asarray(fx))
    j32 = [np.asarray(out[k], np.float32) for k in ("moved", "warp")]

    fn, _ = tentry.entry("cpu")
    got = fn(params_from_jax(jparams, tentry.CFG), torch.from_numpy(mov), torch.from_numpy(fx))
    got = [g.float().numpy() for g in got]
    if scale != 1.0:
        assert np.abs(j32[1]).max() > 0.5  # a real field, not the identity
    for name, g, w16, w32 in zip(("moved", "warp"), got, j16, j32):
        assert g.shape == w16.shape, name
        own = np.abs(w16 - w32).max()
        err = np.abs(g - w16).max()
        assert err <= 2 * own, (name, err, own)


def test_fn_computes_with_the_params_it_is_given():
    fn, (params, _, _) = tentry.entry("cpu")
    before = {k: v.clone() for k, v in params.items()}
    rng = np.random.default_rng(2)
    mov, fx = (torch.from_numpy(rng.random(SMALL, np.float32)) for _ in range(2))
    zero_flow = dict(params, **{"flow.weight": torch.zeros_like(params["flow.weight"])})
    moved, warp = fn(zero_flow, mov, fx)
    assert not warp.any() and torch.equal(moved, mov)
    moved, warp = fn(params, mov, fx)
    assert warp.abs().max() > 0 and not torch.is_inference(params["flow.weight"])
    assert all(torch.equal(params[k], v) for k, v in before.items())


def test_entry_runs_on_the_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
