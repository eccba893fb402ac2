"""Export the port's :class:`VxmDense` weights to a Keras-layout ``.h5`` file.

Counterpart of ``multimodal_registration_tpu/models/h5_export.py`` and the
inverse of :mod:`h5_import`: writes the ``model_weights/<layer>/<layer>/
kernel:0`` / ``bias:0`` datasets with the ``layer_names`` / ``weight_names``
attributes that ``keras.Model.load_weights`` (and both packages' importers)
walk, one ``vxm_dense_conv_<i>`` layer per conv in :func:`conv_module_order`
and the flow head last. Kernels go back from the port's ``(Cout, Cin, 3, 3,
3)`` to Keras's ``(3, 3, 3, Cin, Cout)``, in float32. Needs ``h5py``,
imported when a file is written.
"""

from __future__ import annotations

import numpy as np

from multimodal_registration_torch.models.h5_import import _h5py, conv_module_order
from multimodal_registration_torch.models.vxm_dense import VxmConfig
from multimodal_registration_torch.models.weights import params_to_jax


def export_keras_vxm_h5(state_dict: dict, cfg: VxmConfig, h5path: str) -> None:
    """Write ``state_dict`` (a :class:`VxmDense` with ``cfg``) as a Keras
    legacy-h5 weight file."""
    h5py = _h5py()
    flat = params_to_jax(state_dict)
    targets = [f"unet/{name}/conv" for name in conv_module_order(cfg)] + ["flow"]
    layers = [(f"vxm_dense_conv_{li}", flat[f"params/{t}/kernel"], flat[f"params/{t}/bias"])
              for li, t in enumerate(targets)]

    with h5py.File(h5path, "w") as f:
        mw = f.create_group("model_weights")
        for lname, kernel, bias in layers:
            g = mw.create_group(lname)
            g.create_dataset(f"{lname}/kernel:0", data=np.asarray(kernel, np.float32))
            g.create_dataset(f"{lname}/bias:0", data=np.asarray(bias, np.float32))
            g.attrs["weight_names"] = [f"{lname}/kernel:0".encode(), f"{lname}/bias:0".encode()]
        mw.attrs["layer_names"] = [lname.encode() for lname, _, _ in layers]
