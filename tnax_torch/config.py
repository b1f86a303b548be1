"""Device, dtype and matmul-precision settings of the port.

Counterpart of ``tnax/config.py``. tnax forces full-f32 matmuls on the TPU
(its default is bf16 inputs); here the same concern is TF32, which the
card uses for f32 matmuls and convolutions when allowed. Conditional
probabilities are ratios spanning many orders of magnitude, so both TF32
switches stay off and the f32 matmul precision stays "highest".

Entry points run on the card unless the caller asks for the CPU: no
device means CUDA, and without a CUDA card that is an error, not a quiet
move to the CPU. The dtype is a parameter: float64 on the CPU (parity
with tnax in f64), float32 by default on CUDA, float64 on CUDA as a
measured alternative.
"""

from __future__ import annotations

import time

import torch


def ensure_precision() -> None:
    """Turn TF32 off for matmuls and cuDNN (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class StageClock:
    """Seconds per pipeline stage, each ended by a device synchronize and
    added to the stage's entry of the dict (a stage run twice, as in a
    retried search, counts twice); inert when no dict is given."""

    def __init__(self, out, device):
        self.out, self.device = out, device
        self.t = time.perf_counter() if out is not None else None

    def lap(self, name):
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name] = self.out.get(name, 0.0) + now - self.t
        self.t = now


def resolve_device(device=None):
    """The torch.device: CUDA unless one is given. Raises RuntimeError
    for CUDA on a machine without it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the port runs on CUDA by default; "
                           "pass device='cpu' to run on the CPU")
    return device


def resolve(device=None, dtype=None):
    """(torch.device, dtype) with the port's defaults: CUDA unless a
    device is given, float64 on the CPU and float32 on CUDA unless a dtype
    is given. Raises RuntimeError for CUDA on a machine without it."""
    ensure_precision()
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.float32 if device.type == "cuda" else torch.float64
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"compute dtype must be float32 or float64, "
                         f"got {dtype}")
    return device, dtype
