"""Device ms a pair of the operations launched under the U-Net's span
(``models/unet.py``: K1 and cuDNN; moves ``pairs_per_s``)."""


def read(trace):
    ops = trace.under("unet")
    if not ops or not trace.units:
        return None
    return 1e3 * trace.device_s(ops) / trace.units
