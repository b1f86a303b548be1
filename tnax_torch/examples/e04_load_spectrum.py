"""Load a saved spectrum, decode states, verify energies independently
(the port of tnax's ``examples/e04_load_spectrum.py``, reference
`examples/e04_load_spectrum_droplet_instances.py`)."""

import argparse
import logging

import numpy as np

from .. import problems
from ..solver import load
from .common import add_device_argument, load_droplet_instance


def load_and_verify(file_name, L=128, instance=1, dE=1.0, max_states=1000,
                    device=None):
    ins = load(file_name, device=device)
    ins.decode_low_energy_states(max_dEng=dE, max_states=max_states)
    J = load_droplet_instance(L, instance)
    E_check = problems.energy_Jij(J, ins.binary_states())
    err = np.max(np.abs(ins.energy - E_check))
    print("# states:", len(ins.energy))
    print("max |E_solver - E_independent| =", err)
    if not err < 1e-4:
        raise ValueError(f"decoded energies differ from the couplings' by "
                         f"{err}")
    return ins


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("file")
    p.add_argument("-L", type=int, default=128)
    p.add_argument("-ins", type=int, default=1)
    p.add_argument("-dE", type=float, default=1.0)
    p.add_argument("-max_st", type=int, default=1000)
    add_device_argument(p)
    args = p.parse_args()
    logging.basicConfig(level="INFO")
    ins = load_and_verify(args.file, L=args.L, instance=args.ins, dE=args.dE,
                          max_states=args.max_st, device=args.device)
    ins.show_solution()
