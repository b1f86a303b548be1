"""Packaging rules of the port: it never imports jax or tnax, its kernel
wrappers dispatch by device, and chip_smoke.py refuses to run without a
CUDA card or without the package beside it."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tnax_torch
from tnax_torch import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPORT = re.compile(r"^\s*(import|from)\s+(jax|tnax)\b")


def _sources():
    pkg = os.path.dirname(tnax_torch.__file__)
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_tnax_import(path):
    with open(path) as f:
        bad = [line for line in f if IMPORT.match(line)]
    assert not bad, bad


def test_wrappers_count_no_launch_on_cpu():
    kernels.reset_launch_counts()
    A = torch.as_tensor(np.eye(4) * [1.0, 1e6, 1.0, 1e-6])
    kernels.gebal_scale(A[None], torch.tensor([4]), 32.0)
    assert kernels.launch_counts() == dict(gebal=0, merge=0,
                                           marginal_epilogue=0)


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
