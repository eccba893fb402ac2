"""Carry weights, gradients and updated parameters between the JAX package's
format and the port's.

The JAX package stores parameters flat, one array per key, as written by
``train/trainer.py::_flatten_params``: ``params/unet/enc_0/conv/kernel`` of
shape ``(3, 3, 3, Cin, Cout)``, ``params/unet/enc_0/conv/bias``,
``params/flow/kernel``, ... (the in-repo ``benchmarks/*.npz`` files). The
port's module tree has the same names: ``unet.enc_0.conv.weight`` of shape
``(Cout, Cin, 3, 3, 3)``, ``flow.weight``, ...

The int8 activation scales are the JAX package's ``"quant"`` collection, a
nested dict ``{"unet": {"enc_1": {"amax": scalar}}}``; the port keeps them
flat, ``{"unet/enc_1/amax": numpy float32}`` (:func:`quant_from_jax`,
:func:`quant_to_jax`).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense


def _flatten(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, name))
        else:
            out[name] = v
    return out


def _port_key(jax_key: str) -> str:
    parts = jax_key.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def expected_shapes(cfg: VxmConfig) -> dict:
    """State-dict key -> shape of a :class:`VxmDense` with ``cfg`` (built on
    the meta device: no memory, no compute)."""
    model = VxmDense(cfg, device="meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def params_from_jax(flat, cfg: VxmConfig) -> dict:
    """State dict of a :class:`VxmDense` with ``cfg`` from JAX parameters.

    ``flat``: a dict of arrays in the flat key format above, or a nested
    Flax params tree (flattened the same way). Kernels go ``(3, 3, 3, Cin,
    Cout)`` -> ``(Cout, Cin, 3, 3, 3)``. Every key and shape is checked: a
    missing, extra or misshaped parameter raises. Returns float32 CPU tensors.
    """
    flat = _flatten(flat) if any(isinstance(v, Mapping) for v in flat.values()) else flat
    want = expected_shapes(cfg)
    got = {}
    for key, arr in flat.items():
        name = _port_key(key)
        if name not in want:
            raise KeyError(f"unexpected parameter {key!r} for {cfg}")
        a = np.array(arr, np.float32)  # a copy: the source may be read-only
        if name.endswith(".weight"):
            if a.ndim != 5:
                raise ValueError(f"{key}: expected a 5-D conv kernel, got shape {a.shape}")
            a = a.transpose(4, 3, 0, 1, 2)
        if a.shape != want[name]:
            raise ValueError(f"shape mismatch for {key}: {a.shape} vs {want[name]} (port layout)")
        got[name] = torch.from_numpy(np.ascontiguousarray(a))
    missing = sorted(set(want) - set(got))
    if missing:
        raise KeyError(f"missing parameters {missing} for {cfg}")
    return got


def params_to_jax(state_dict: dict) -> dict:
    """Inverse of :func:`params_from_jax`: the flat JAX key format, numpy."""
    out = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        a = t.detach().cpu().numpy()
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            a = a.transpose(2, 3, 4, 1, 0)
        out["/".join(["params", *parts])] = np.ascontiguousarray(a)
    return out


def grads_to_jax(model: torch.nn.Module) -> dict:
    """The gradients held by ``model``'s parameters in the flat JAX key format
    and kernel layout (what ``_flatten_params`` gives for ``jax.grad``'s
    tree), for leaf-by-leaf comparison. A parameter without a gradient
    raises: it would otherwise pass as a zero."""
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    if missing:
        raise ValueError(f"parameters without a gradient: {missing}")
    return params_to_jax({n: p.grad for n, p in model.named_parameters()})


def quant_from_jax(quant) -> dict:
    """The JAX ``"quant"`` collection (nested, or already flat) as the port's
    flat scales, ``{"unet/enc_1/amax": numpy float32}``."""
    flat = _flatten(quant) if any(isinstance(v, Mapping) for v in quant.values()) else quant
    return {k: np.float32(np.asarray(v)) for k, v in flat.items()}


def quant_to_jax(scales: dict) -> dict:
    """Inverse of :func:`quant_from_jax`: the nested ``"quant"`` collection."""
    out: dict = {}
    for key, v in scales.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.float32(v)
    return out
