"""Hand-written Hopper kernels of the port and their plain versions.

=====  ===================================  ==========================
K1     ``gebal.gebal_scale``                CUDA C++ (csrc/gebal.cu)
K2     ``merge.merge_segments``             CUDA C++ (csrc/merge.cu)
K3     ``marginal.marginal_epilogue``       Triton (marginal_triton.py)
=====  ===================================  ==========================

Each wrapper runs its plain PyTorch version for CPU tensors, launches its
kernel for CUDA tensors (or raises), and counts its launches in the
integer attribute ``launches``.
"""

from .gebal import gebal_scale, gebal_scale_plain
from .marginal import marginal_epilogue, marginal_epilogue_plain
from .merge import merge_segments, merge_segments_plain

WRAPPERS = {"gebal": gebal_scale, "merge": merge_segments,
            "marginal_epilogue": marginal_epilogue}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["gebal_scale", "gebal_scale_plain", "marginal_epilogue",
           "marginal_epilogue_plain", "merge_segments",
           "merge_segments_plain", "WRAPPERS", "reset_launch_counts",
           "launch_counts"]
