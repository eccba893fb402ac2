"""multimodal_registration_torch — the PyTorch/CUDA port of
``multimodal_registration_tpu`` for NVIDIA Hopper (H100).

The module tree mirrors the JAX package (``ops/warp.py``, ``models/unet.py``,
``infer/register.py``, ...) so that each function has an obvious counterpart.
Public functions keep the JAX package's channels-last layout: volumes
``(B, X, Y, Z, C)``, displacement fields ``(B, X, Y, Z, 3)``.

Entry points (``Registrar``, ``register``, the pair CLI) run on ``cuda``
unless the caller passes ``device="cpu"``; without a GPU and without an
explicit ``cpu`` they raise. The hand-written kernels (``csrc/``) are built
with ``nvcc`` at first use (``kernels.py``); on CPU tensors each kernel
wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
