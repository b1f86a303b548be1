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

import contextvars
import time

import torch


def ensure_precision() -> None:
    """Turn TF32 off for matmuls and cuDNN (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# the clock of the stage that records now (see StageClock), per thread
_RECORDING = contextvars.ContextVar("tnax_torch_stage_clock", default=None)


def recording():
    """The :class:`StageClock` that records the stage running now, or
    None: code below a stage reaches the clock through this, and does
    nothing more when it is None."""
    return _RECORDING.get()


class StageClock:
    """The port's recorder of stage seconds and counters into the caller's
    ``stage_times`` dict; inert when no dict is given.

    :meth:`lap` ends a stage with a device synchronize and adds its
    seconds (from the previous lap or the clock's start) to the stage's
    key: a stage run twice, as in a retried search or a second rung,
    counts twice. Used as a context manager (``with StageClock(out, dev)
    as clock:``) with a dict, the clock is the one :func:`recording`
    returns until the block ends, so that the code below the stage adds
    to it without being handed it:

    - :meth:`leaf` ends a sub-span of the running stage (``"ladder/build"``)
      with a synchronize, its seconds taken from the previous key written;
      the stage's own key keeps its full seconds;
    - :meth:`count` adds to a counter, and :meth:`read` times a host read
      that waits for the device (counter ``wait_s``, the read's return
      time in ``read_end``). Counters accumulate until the next key is
      written and go in right after it as ``<key>#<counter>``, when not
      zero. The synchronize that ends a key counts as a wait of that key.
    """

    def __init__(self, out, device):
        self.out, self.device = out, device
        self.t = self.mark = time.perf_counter() if out is not None else None
        self.counters = {}
        self.read_end = None
        self._token = None

    def __enter__(self):
        if self.out is not None:
            self._token = _RECORDING.set(self)
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            _RECORDING.reset(self._token)
            self._token = None

    def count(self, name, value):
        self.counters[name] = self.counters.get(name, 0) + value

    def read(self, fn, *args):
        """``fn(*args)``, a read that waits for the device, timed."""
        t = time.perf_counter()
        out = fn(*args)
        self.read_end = time.perf_counter()
        self.count("wait_s", self.read_end - t)
        return out

    def _write(self, name, start):
        if self.device.type == "cuda":
            self.read(torch.cuda.synchronize, self.device)
        now = time.perf_counter()
        out = self.out
        out[name] = out.get(name, 0.0) + now - start
        for k, v in self.counters.items():
            if v:
                key = f"{name}#{k}"
                out[key] = out.get(key, 0) + v
        self.counters.clear()
        self.mark = now
        return now

    def lap(self, name):
        """End the stage ``name``."""
        if self.out is None:
            return
        self.t = self._write(name, self.t)

    def leaf(self, name):
        """End the sub-span ``name`` of the running stage."""
        self._write(name, self.mark)


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
