"""Device selection and the float32 precision policy.

Importing this module turns TF32 off for float32 matrix products and
convolutions. The JAX reference runs float32 storage at full precision
(``Precision.HIGHEST`` inside its Pallas kernels); TF32 keeps about three
decimal digits and would break the port's float32 tolerances (value rtol
1e-5, gradient rtol/atol 1e-4).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (explicitly or by default) and
    absent: the port never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def check_device(data_device: torch.device, device=None) -> torch.device:
    """``resolve_device(device)``, and a check that data the caller built
    already lies there: an entry point never copies the data across."""
    dev = resolve_device(device)
    if data_device.type != dev.type or (
        dev.index is not None and data_device.index != dev.index
    ):
        raise ValueError(f"the data lies on {data_device}, not on {dev}")
    return data_device
