"""Several devices from one process (counterpart of
``multimodal_registration_tpu/parallel/``): the ``(data, space)`` mesh
(``mesh.py``) and the U-Net on X slabs with halo exchanges (``spatial.py``)."""

from multimodal_registration_torch.parallel.mesh import (
    Mesh,
    first_device,
    gather,
    make_mesh,
    mesh_devices,
    replicate,
    setup_devices,
    split_rows,
    split_slabs,
)

__all__ = ["Mesh", "first_device", "gather", "make_mesh", "mesh_devices", "replicate",
           "setup_devices", "split_rows", "split_slabs"]
