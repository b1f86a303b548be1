"""Device, dtype and matmul-precision settings of the port.

Counterpart of ``tnax/config.py``. tnax forces full-f32 matmuls on the TPU
(its default is bf16 inputs); here the same concern is TF32, which the
card uses for f32 matmuls and convolutions when allowed. Conditional
probabilities are ratios spanning many orders of magnitude, so both TF32
switches stay off and the f32 matmul precision stays "highest".

The dtype is a parameter: float64 on the CPU (parity with tnax in f64),
float32 by default on CUDA, float64 on CUDA as a measured alternative.
"""

from __future__ import annotations

import torch


def ensure_precision() -> None:
    """Turn TF32 off for matmuls and cuDNN (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve(device=None, dtype=None):
    """(torch.device, dtype) with the port's defaults: CUDA when asked
    for, float64 on the CPU and float32 on CUDA unless given."""
    ensure_precision()
    device = torch.device("cpu" if device is None else device)
    if dtype is None:
        dtype = torch.float32 if device.type == "cuda" else torch.float64
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"compute dtype must be float32 or float64, "
                         f"got {dtype}")
    return device, dtype
