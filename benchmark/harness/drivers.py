"""What the drivers share: a Solver made from an instance as e01 loads
one."""

from __future__ import annotations


def solver(tt, cfg, rows, device, dtype):
    """A Solver on droplet-file rows, loaded as e01 loads an instance."""
    inst = cfg["instance"]
    n = inst["cells"]
    J = tt.round_Jij(tt.Jij_f2p(rows), 1 / inst["coupling_levels"])
    return J, tt.Solver(mode="Ising", Nx=n, Ny=n,
                        Nc=inst["spins_per_cell"], J=J,
                        beta=cfg["solver"]["beta"], device=device,
                        dtype=dtype)

