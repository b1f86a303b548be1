"""ctypes binding of the droplet store's C code (``droplets.c``, a copy of
tnax's ``tnax/native/droplets.c``).

At first use the source is compiled with the system C compiler (``$CC``,
else the first of cc, gcc and clang on the PATH) into ``build/tnax_torch/``
at the root of the checkout (listed in ``.gitignore``), under a name that
carries a hash of the source, and loaded. A failed build raises: the
spectrum's NumPy versions run only where the caller asks for them
(``native=False``), never in place of a build that failed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "droplets.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tnax_torch"
CFLAGS = ["-O2", "-shared", "-fPIC"]

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_ptr = ctypes.c_void_p
_i64 = ctypes.c_int64

# entry points: (restype, argtypes). The raw-pointer ones take
# ``array.ctypes.data``: ndpointer checks cost ~50 us a call, and these are
# called once per droplet or per site.
_SIGNATURES = {
    "tnax_hd_pair_ising": (_i64, [_i64p, _i64p, _i64, _i64p, _i64p, _i64]),
    "tnax_hd_pair_rmf": (_i64, [_i64p, _i64p, _i64, _i64p, _i64p, _i64]),
    "tnax_merge_shapes": (_i64, [_i64p, _i64p, _i64, _i64p, _i64p, _i64,
                                 _i64p, _i64p]),
    "tnax_elementary": (ctypes.c_int, [_u64p, _i64, _i64p, _i64]),
    "tnax_spins": (_i64, [_ptr] * 5 + [_i64, _ptr]),
    "tnax_elem_batch": (ctypes.c_int, [_ptr] * 4 + [_i64, _ptr, _ptr, _ptr,
                                                    _i64, _i64, _ptr]),
    "tnax_unpack_v2": (_i64, [_ptr] * 6 + [_i64] * 3
                       + [ctypes.c_double, _i64, ctypes.c_int]),
    "tnax_unpack_flip_total": (_i64, []),
    "tnax_unpack_fetch": (None, [_ptr] * 3),
}


def _compiler() -> str:
    cc = os.environ.get("CC") or next(
        (c for c in ("cc", "gcc", "clang") if shutil.which(c)), None)
    if cc is None:
        raise RuntimeError("no C compiler found ($CC, cc, gcc, clang) for "
                           "the droplet code; pass native=False to run its "
                           "NumPy versions")
    return cc


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises if the build
    fails."""
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CFLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libdroplets_{digest[:12]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # link to a temporary name and rename: overwriting a library in
        # place would truncate pages another process has mapped
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(_compiler().split() + CFLAGS
                              + ["-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SRC.name} failed:\n{proc.stderr}")
        os.replace(tmp, so)
    L = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _SIGNATURES.items():
        f = getattr(L, name)
        f.restype, f.argtypes = restype, argtypes
    return L


def check(ret, what):
    """A native call's result, or MemoryError where it reports a failed
    allocation (a negative value)."""
    if ret < 0:
        raise MemoryError(f"{what}: the droplet code could not allocate")
    return ret
