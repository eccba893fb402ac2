"""Device meshes: counterpart of ``multimodal_registration_tpu/parallel/mesh.py``.

The port is single-controller, as the JAX package is: one process holds a
``(data, space)`` array of ``torch.device``s. The batch is split over
``data`` (inference and training) and, in inference, each volume's X axis
over ``space`` (``parallel/spatial.py``). Tensors are placed on those
devices and moved between them by explicit copies; no process group is
involved, so nothing needs a launcher. A mesh may name one device more than
once: the CPU tests run a 2-way mesh on ``cpu`` twice, and a one-card
machine runs one on ``cuda:0`` twice (the work is split and the halos are
copied all the same).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device


class Mesh:
    """A ``(data, space)`` grid of devices: ``devices`` is the object array,
    ``shape`` ``{"data": ..., "space": ...}``; ``home`` is the first device,
    where a caller's inputs and outputs live."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty (data, space) grid, got {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return {"data": self.devices.shape[0], "space": self.devices.shape[1]}

    @property
    def home(self) -> torch.device:
        return self.devices[0, 0]

    def distinct(self) -> list:
        """The mesh's devices without repeats, in mesh order."""
        return list(dict.fromkeys(self.devices.ravel().tolist()))

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, space={self.shape['space']}: "
                f"{', '.join(str(d) for d in self.devices.ravel())})")


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the card it means (``cuda:k``), so devices compare equal
    to those of the tensors placed on them."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def setup_devices(device_spec=None):
    """Parity with ``setup_device(gpu)``: the devices a spec names, in order.
    The spec is a comma-separated string or a list; an index (``"0,1"``)
    selects that CUDA card and is dropped past the last card, as in the JAX
    package; a name (``"cuda:1"``, ``"cpu"``) is that device, and may repeat
    (``"cuda:0,cuda:0"``). ``""``/``None``/``"-1"`` means every card.
    Returns ``(devices, count)``."""
    if device_spec in (None, "", "-1", -1):
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return devs, len(devs)
    items = device_spec.split(",") if isinstance(device_spec, str) else list(device_spec)
    n_cards = torch.cuda.device_count()
    devs = []
    for item in items:
        if str(item).strip().isdigit():
            if int(item) < n_cards:
                devs.append(torch.device("cuda", int(item)))
        else:
            devs.append(_indexed(resolve_device(item)))
    return devs, len(devs)


def mesh_devices(device=None, n: int = 1) -> list:
    """The devices an entry point's ``device`` argument offers a layout of
    ``n`` devices: a list or a comma-separated string names them
    (:func:`setup_devices`); ``"cuda"`` (the default) is every card;
    ``"cuda:k"`` that card alone; ``"cpu"`` the CPU, ``n`` times."""
    if isinstance(device, (list, tuple)) or (isinstance(device, str) and "," in device):
        return setup_devices(device)[0]
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * max(1, n)
    if dev.index is None:
        return setup_devices()[0]
    return [dev]


def first_device(device=None) -> torch.device:
    """Where an entry point given ``device`` keeps its inputs and outputs:
    the first device of a list, else ``device`` itself (default: the GPU)."""
    if isinstance(device, (list, tuple)) or (isinstance(device, str) and "," in device):
        return mesh_devices(device)[0]
    return resolve_device(device)


def make_mesh(n_devices: int | None = None, space: int = 1, devices=None) -> Mesh:
    """A ``(data, space)`` mesh over the first ``n_devices`` of ``devices``
    (default: every card)."""
    if devices is None:
        devices = setup_devices()[0]
    devices = [_indexed(torch.device(d)) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices}, "
                         f"have {len(devices)}")
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices[:n_devices]
    if space > 1 and n_devices % space:
        raise ValueError(f"{n_devices} devices not divisible by space={space}")
    return Mesh(grid.reshape(n_devices // max(space, 1), max(space, 1)))


def split_rows(x: torch.Tensor, mesh: Mesh) -> list:
    """``x (B, ...)`` split over ``data`` (the batch sharding): row ``r``'s
    share on its first device. ``B`` must divide by ``data``."""
    data = mesh.shape["data"]
    if x.shape[0] % data:
        raise ValueError(f"batch {x.shape[0]} not divisible by the data axis ({data})")
    return [part.to(mesh.devices[r, 0]) for r, part in enumerate(x.chunk(data))]


def split_slabs(x: torch.Tensor, devices) -> list:
    """``x (B, X, ...)`` cut into ``len(devices)`` equal slabs along X, slab
    ``k`` on ``devices[k]`` (the ``space`` sharding)."""
    if x.shape[1] % len(devices):
        raise ValueError(f"X {x.shape[1]} not divisible by {len(devices)} slabs")
    return [s.to(d) for s, d in zip(x.chunk(len(devices), dim=1), devices)]


def gather(parts, device, dim: int = 0) -> torch.Tensor:
    """The parts copied to ``device`` and concatenated along ``dim``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def replicate(module: torch.nn.Module, devices) -> dict:
    """One copy of ``module`` per distinct device (the replicated sharding):
    ``{device: module}``, ``module`` itself on its own device."""
    home = next(module.parameters()).device
    return {d: module if d == home else copy.deepcopy(module).to(d)
            for d in dict.fromkeys(devices)}
