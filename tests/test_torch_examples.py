"""The port's examples (tnax_torch/examples, tnax's e01-e07) on the CPU,
at small widths, on a temporary instance tree in the reference's layout
filled from tests/data: chimera128_synth_s0 as chimera-128 droplet
instance 1 (held to its tnax oracles) and chimera512_synth_s1 as J124
instance 1 at C=8."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import tnax_torch as tt
from tnax_torch.examples import (common, e01_search_gs, e02_sample,
                                 e03_search_spectrum, e04_load_spectrum,
                                 e05_minimal_rmf,
                                 e06_search_gs_degeneracy_j124,
                                 e07_fleet_sweep)
import torch_helpers  # noqa: F401  (the thread policy)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(D=16, M=256, precondition=False, device="cpu")


def _oracle(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("instances")
    for src, dst in (("chimera128_synth_s0.txt", "Chimera_droplet_instances/"
                      "chimera128_spinglass_power/001.txt"),
                     ("chimera512_synth_s1.txt",
                      "Chimera_J124/C=8_J124/001.txt")):
        os.makedirs(os.path.dirname(root / dst), exist_ok=True)
        shutil.copy(os.path.join(DATA, src), root / dst)
    return str(root)


@pytest.fixture
def instances(tree, monkeypatch):
    monkeypatch.setenv("TNAX_INSTANCES", tree)
    return tree


def _recheck(J, ins):
    return tt.energy_Jij(J, ins.binary_states())


@pytest.mark.parametrize("path", ["host", "device"])
def test_e01_reaches_the_oracle(instances, path):
    orc = _oracle("chimera128_synth_s0_oracle.json")
    ins = e01_search_gs.search_gs_droplet(path=path, **SMALL)
    assert ins.energy[0] == pytest.approx(orc["energy"], abs=1e-9)
    assert ins.degeneracy == orc["degeneracy"]
    J = common.load_droplet_instance(128, 1)
    assert _recheck(J, ins)[0] == pytest.approx(orc["energy"], abs=1e-9)


def test_e02_energies_are_those_of_the_states(instances):
    ins = e02_sample.gibbs_sampling(D=8, M=16, precondition=False,
                                    device="cpu")
    assert ins.energy.shape == (16,)
    np.testing.assert_allclose(
        ins.energy, _recheck(common.load_droplet_instance(128, 1), ins),
        rtol=0, atol=1e-9)


def test_e03_saves_what_e04_loads_and_verifies(instances, tmp_path):
    orc = _oracle("chimera128_synth_s0_spectrum_oracle.json")["runs"][0]
    ins = e03_search_spectrum.search_spectrum_droplet(path="device", **SMALL)
    assert ins.merge_overflow == 0
    ins.save(str(tmp_path / "sol.npy"))
    got = e04_load_spectrum.load_and_verify(str(tmp_path / "sol.npy"),
                                            dE=1.0, device="cpu")
    assert len(got.energy) == orc["n_states"]
    np.testing.assert_allclose(np.sort(got.energy), np.sort(orc["energies"]),
                               rtol=0, atol=1e-9)


def test_e05_gives_26_states():
    ins = e05_minimal_rmf.minimal_RMF(device="cpu")
    assert len(ins.energy) == 26


def test_e06_loads_j124_and_searches(instances):
    ins = e06_search_gs_degeneracy_j124.search_gs_J124(
        D=8, M=64, precondition=False, device="cpu")
    J = common.load_j124_instance(8, 1)
    assert ins.degeneracy >= 1
    assert _recheck(J, ins)[0] == pytest.approx(ins.energy[0], abs=1e-9)


def test_e07_pads_a_batch_of_two(instances):
    orc = _oracle("chimera128_synth_s0_oracle.json")
    E = e07_fleet_sweep.fleet_sweep(L=128, n=1, batch=2, D=8, M=64,
                                    device="cpu")
    assert list(E) == [1]
    assert E[1] == pytest.approx(orc["energy"], abs=1e-9)


@pytest.mark.parametrize("args", [
    ["e05_minimal_rmf", "-M", "256"],
    ["e01_search_gs", "-D", "8", "-M", "64", "-no-pre"]])
def test_scripts_run_with_a_device_flag(instances, args):
    # one thread in the script too, as in this module's own process
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", f"tnax_torch.examples.{args[0]}", *args[1:],
         "-device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Energ" in out.stdout


def test_examples_default_to_the_card(instances):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        e05_minimal_rmf.minimal_RMF()
