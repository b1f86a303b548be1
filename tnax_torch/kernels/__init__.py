"""Hand-written Hopper kernels of the port and their plain versions.

=====  ===================================  ==========================
K1     ``gebal.gebal_scale``                CUDA C++ (csrc/gebal.cu)
K2     ``merge.merge_segments``             CUDA C++ (csrc/merge.cu)
K3     ``marginal.marginal_epilogue``       CUDA C++ (csrc/marginal.cu)
K4     ``sample.sample_site``               CUDA C++ (csrc/sample.cu)
K5     ``polish.polish_row``                CUDA C++ (csrc/polish.cu)
K6     ``zipup.zipup_row``                  CUDA C++ (csrc/zipup.cu)
K7     ``svd.svd_fixed``, ``svd.svdvals``   CUDA C++ (csrc/svd.cu)
=====  ===================================  ==========================

K3 and K4 share the marginal epilogue, ``csrc/epilogue.cuh``. Each
wrapper runs its plain PyTorch version for CPU tensors, launches its
kernel for CUDA tensors (or raises), and counts its launches in the
integer attribute ``launches``.
"""

from .gebal import gebal_scale, gebal_scale_plain
from .marginal import marginal_epilogue, marginal_epilogue_plain
from .merge import merge_segments, merge_segments_plain
from .polish import polish_row, polish_row_plain
from .sample import sample_draw_plain, sample_site, sample_site_plain
from .svd import svd_fixed, svd_fixed_plain, svdvals, svdvals_plain
from .zipup import zipup_row, zipup_row_plain

WRAPPERS = {"gebal": gebal_scale, "merge": merge_segments,
            "marginal_epilogue": marginal_epilogue,
            "sample_site": sample_site, "polish": polish_row,
            "zipup": zipup_row, "svd": svd_fixed}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["gebal_scale", "gebal_scale_plain", "marginal_epilogue",
           "marginal_epilogue_plain", "merge_segments",
           "merge_segments_plain", "polish_row", "polish_row_plain",
           "sample_draw_plain", "sample_site",
           "sample_site_plain", "svd_fixed", "svd_fixed_plain", "svdvals",
           "svdvals_plain", "zipup_row", "zipup_row_plain", "WRAPPERS",
           "reset_launch_counts",
           "launch_counts"]
