"""A fixed callable and fixed inputs of the flagship forward.

    from multimodal_registration_torch.entry import entry
    fn, example_args = entry()            # on the card
    moved, warp = fn(*example_args)

The port's counterpart of ``__graft_entry__.py::entry()``: the forward
registration step (moved image and the diffeomorphic warp at half
resolution) of the flagship SynthMorph model, ``VxmDense`` with enc [64]x4,
dec [64]x6, ``int_steps`` 5, ``int_res`` = ``svf_res`` = 2, bf16 (the
reference training architecture, ``config/config.json``). It is the callable
that a CUDA graph of the forward, or any other whole-forward optimisation,
works on.

``entry(device=None)`` returns ``(fn, example_args)``:

* ``example_args = (params, moving, fixed)``: ``params`` is the model's state
  dict, initialised as the JAX ``init_params(cfg, inshape=(32, 32, 32))``
  initialises it (``train/trainer.py::init_like_flax_``, seed 0);
  ``moving`` and ``fixed`` are float32 zeros ``(1, 160, 160, 192, 1)``;
* ``fn(params, moving, fixed)`` returns ``(moved, warp)``, ``(1, X, Y, Z, 1)``
  and ``(1, X/2, Y/2, Z/2, 3)``. It runs the model under
  ``torch.inference_mode()`` through ``torch.func.functional_call``, so the
  ``params`` given are the ones computed with (another state dict, for
  example ``models/weights.py::params_from_jax`` of a checkpoint, on the same
  device), and no copy of them is made per call. With no gradient asked,
  the path is K1 (enc_0), cuDNN, the float32 head, K2's fused squaring step
  x5 and K3.

Everything lives on ``resolve_device(device)``: the card unless
``device="cpu"``.
"""

from __future__ import annotations

import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.train.trainer import init_like_flax_

CFG = VxmConfig(enc=(64, 64, 64, 64), dec=(64, 64, 64, 64, 64, 64), int_steps=5, int_res=2,
                svf_res=2, compute_dtype="bfloat16")
SHAPE = (1, 160, 160, 192, 1)
SEED = 0


def entry(device=None):
    """``(fn, example_args)`` of the flagship forward on ``device``."""
    dev = resolve_device(device)
    model = VxmDense(CFG, device=dev)
    init_like_flax_(model, SEED)
    model.eval()

    def fn(params, moving, fixed):
        with torch.inference_mode():
            out = torch.func.functional_call(model, params, (moving, fixed))
        return out["moved"], out["warp"]

    example_args = (model.state_dict(),
                    torch.zeros(SHAPE, dtype=torch.float32, device=dev),
                    torch.zeros(SHAPE, dtype=torch.float32, device=dev))
    return fn, example_args
