"""Import published Keras VoxelMorph ``.h5`` weights into the port's
:class:`VxmDense` state dict.

Counterpart of ``multimodal_registration_tpu/models/h5_import.py``. A Keras
VxmDense ``.h5`` holds the U-Net's 3-D conv kernels in layer order (encoder,
decoder, final convs) and then the flow head. They are collected in
``layer_names`` order and mapped by position onto the module order of
:func:`conv_module_order`, every shape checked. A layer without a bias keeps
a zero bias. Needs ``h5py``, imported when a file is read.
"""

from __future__ import annotations

import numpy as np

from multimodal_registration_torch.models.vxm_dense import VxmConfig
from multimodal_registration_torch.models.weights import expected_shapes, params_from_jax


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading Keras .h5 weights needs the h5py package, which is not "
            "installed; convert the model to the flat .npz format where h5py is") from e
    return h5py


def _collect_conv_weights(h5path: str):
    """``(layer name, kernel, bias or None)`` of every Conv3D layer, in the
    file's layer order."""
    h5py = _h5py()
    pairs = []
    with h5py.File(h5path, "r") as f:
        grp = f["model_weights"] if "model_weights" in f else f
        layer_names = [n.decode() if isinstance(n, bytes) else n
                       for n in grp.attrs.get("layer_names", list(grp.keys()))]
        for lname in layer_names:
            if lname not in grp:
                continue
            sub = grp[lname]
            weight_names = [n.decode() if isinstance(n, bytes) else n
                            for n in sub.attrs.get("weight_names", [])]
            kernel, bias = None, None
            for wn in weight_names:
                arr = np.asarray(sub[wn])
                if arr.ndim == 5 and wn.endswith(("kernel:0", "kernel")):
                    kernel = arr
                elif arr.ndim == 1 and wn.endswith(("bias:0", "bias")):
                    bias = arr
            if kernel is not None:
                pairs.append((lname, kernel, bias))
    return pairs


def conv_module_order(cfg: VxmConfig) -> list:
    """The U-Net's module names in Keras layer order (the flow head comes
    after them)."""
    return ([f"enc_{i}" for i in range(len(cfg.enc))]
            + [f"dec_{i}" for i in range(len(cfg.enc))]
            + [f"final_{j}" for j in range(len(cfg.dec) - len(cfg.enc))])


def import_keras_vxm_h5(h5path: str, cfg: VxmConfig) -> dict:
    """The state dict (float32 CPU tensors) of a :class:`VxmDense` with
    ``cfg`` whose conv kernels and biases are the ``.h5`` file's."""
    pairs = _collect_conv_weights(h5path)
    order = conv_module_order(cfg)
    if len(pairs) != len(order) + 1:  # + the flow head
        raise ValueError(
            f"h5 file has {len(pairs)} Conv3D layers, expected {len(order) + 1} for "
            f"enc={cfg.enc} dec={cfg.dec}; layers found: {[p[0] for p in pairs]}")
    want = expected_shapes(cfg)
    flat = {}
    targets = [f"unet/{name}/conv" for name in order] + ["flow"]
    for target, (lname, kernel, bias) in zip(targets, pairs):
        port = target.replace("/", ".")
        cout, cin = want[f"{port}.weight"][:2]
        if tuple(kernel.shape) != (3, 3, 3, cin, cout):
            raise ValueError(f"kernel shape mismatch importing {lname} -> {target}: "
                             f"{kernel.shape} vs {(3, 3, 3, cin, cout)}")
        flat[f"params/{target}/kernel"] = np.asarray(kernel, np.float32)
        flat[f"params/{target}/bias"] = (np.zeros(cout, np.float32) if bias is None
                                         else np.asarray(bias, np.float32))
    return params_from_jax(flat, cfg)
