"""Packaging rules of the port: it and its chip scripts never import jax
or tnax, its kernel wrappers dispatch by device, its droplet C code builds
into build/tnax_torch/ or raises, and chip_smoke.py refuses to run
without a CUDA card or without the package beside it."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tnax_torch
from tnax_torch import bmps, kernels, native
import torch_helpers  # noqa: F401  (the thread policy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPORT = re.compile(r"^\s*(import|from)\s+(jax|tnax)\b")


def _sources():
    pkg = os.path.dirname(tnax_torch.__file__)
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "tools", "profile_port.py")
    yield os.path.join(ROOT, "tools", "smoke_ab.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_tnax_import(path):
    with open(path) as f:
        bad = [line for line in f if IMPORT.match(line)]
    assert not bad, bad


def test_scan_covers_the_spectrum_modules():
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    for m in ("search.py", "spectrum.py", "sample.py", "native/__init__.py"):
        assert os.path.join("tnax_torch", m) in names, m


def test_native_builds_into_build_dir_and_raises_on_failure(tmp_path,
                                                          monkeypatch):
    lib = native.lib()
    assert lib.tnax_hd_pair_ising is not None
    built = list((native.BUILD_DIR).glob("libdroplets_*.so"))
    assert built and native.BUILD_DIR.parts[-2:] == ("build", "tnax_torch")
    native.lib.cache_clear()
    try:
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
        monkeypatch.setenv("CC", "false")
        with pytest.raises(RuntimeError, match="droplets.c"):
            native.lib()
    finally:
        native.lib.cache_clear()
    with pytest.raises(MemoryError):
        native.check(-1, "tnax_unpack_v2")
    assert native.check(3, "tnax_unpack_v2") == 3


def test_wrappers_count_no_launch_on_cpu():
    kernels.reset_launch_counts()
    A = torch.as_tensor(np.eye(4) * [1.0, 1e6, 1.0, 1e-6])
    kernels.gebal_scale(A[None], torch.tensor([4]), 32.0)
    T2 = torch.ones((1, 3, 4), dtype=torch.float64)
    lB = torch.zeros((1, 4, 2, 2), dtype=torch.float64)
    states = torch.zeros((1, 3, 1), dtype=torch.int32)
    kernels.sample_site(
        T2, lB.movedim(1, -1), torch.arange(4)[None],
        torch.zeros((1, 4), dtype=torch.int32),
        torch.zeros((1, 4), dtype=torch.int32), torch.tensor([4]),
        torch.tensor([[0.0, 0.3, 0.99]], dtype=torch.float64),
        torch.ones((1, 2, 2, 2), dtype=torch.float64),
        torch.ones((1, 3, 2), dtype=torch.float64),
        torch.zeros((1, 3, 2), dtype=torch.int32), states, 0, 0,
        torch.zeros(1, dtype=torch.float64))
    assert states[..., 0].tolist() == [[0, 1, 3]]
    key1 = torch.tensor([[3, 1, 3, 0]], dtype=torch.int32)
    perm = kernels.merge_segments(
        key1, torch.zeros((1, 4), dtype=torch.float64), torch.zeros((1, 4)),
        torch.ones((1, 4), dtype=torch.bool),
        torch.ones((1, 4), dtype=torch.int64), 1e-12, key_bits=2)[0]
    assert perm.tolist() == [[3, 1, 0, 2]]
    pmax = kernels.marginal_epilogue(
        T2, lB.movedim(1, -1), torch.arange(4)[None],
        torch.zeros((1, 3), dtype=torch.int64),
        torch.zeros((1, 3), dtype=torch.int64), torch.tensor([4]),
        torch.zeros((1, 3), dtype=torch.float64),
        torch.ones((1, 3), dtype=torch.bool), -30.0)[2]
    assert pmax.tolist() == [-2.0]
    z = torch.zeros((1, 2, 8, 16, 8), dtype=torch.float64)
    z[:, :, 0, 0, 0] = 1.0
    Wc = torch.zeros((1, 2, 16, 16, 16, 16), dtype=torch.float64)
    Wc[:, :, 0, 0, 0, 0] = 1.0
    sweeps = kernels.polish_row(z, z, Wc, tol=1e-10, max_sweeps=2)[3]
    assert sweeps.tolist() == [1]
    omega = bmps.sketch_omega(2, 128, 48, torch.float64, torch.device("cpu"))
    A0 = kernels.zipup_row(z, torch.zeros(1, dtype=torch.float64), Wc,
                           omega, tolS=1e-12)[2]
    assert A0.shape == (1, 2, 8, 16, 8)
    S = kernels.svd_fixed(torch.diag(torch.tensor([1.0, 3.0]))[None])[1]
    assert S.tolist() == [[3.0, 1.0]]
    assert kernels.launch_counts() == dict(gebal=0, merge=0,
                                           marginal_epilogue=0,
                                           sample_site=0, polish=0, zipup=0,
                                           svd=0)


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_cuda():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
