"""Shared helpers of the example scripts: instance paths and loading
(counterpart of ``examples/common.py``). Instances live under
``$TNAX_INSTANCES`` (the ``instances`` directory of a checkout of the
reference; default ``./instances``) in the reference's layout:
``Chimera_droplet_instances/chimera<L>_spinglass_power/<nnn>.txt`` and
``Chimera_J124/C=<C>_J124/<nnn>.txt``."""

import os

from .. import problems

INSTANCE_ROOT = "instances"

CHIMERA_SHAPES = {128: (4, 4, 8), 512: (8, 8, 8),
                  1152: (12, 12, 8), 2048: (16, 16, 8)}


def instance_root():
    """The instance tree: ``$TNAX_INSTANCES`` as it is now, else the
    default."""
    return os.environ.get("TNAX_INSTANCES", INSTANCE_ROOT)


def droplet_instance_path(L, instance):
    return os.path.join(
        instance_root(), "Chimera_droplet_instances",
        f"chimera{L}_spinglass_power", "%03d.txt" % instance)


def load_droplet_instance(L, instance):
    """Couplings of a chimera droplet instance, rounded to multiples of 1/75
    (reference `examples/e01...py:56-65`)."""
    J = problems.load_Jij(droplet_instance_path(L, instance))
    return problems.round_Jij(problems.Jij_f2p(J), 1 / 75)


def load_j124_instance(C, instance):
    path = os.path.join(instance_root(), "Chimera_J124", f"C={C}_J124",
                        "%03d.txt" % instance)
    return problems.Jij_f2p(problems.load_Jij(path))


def add_device_argument(parser):
    """The scripts' ``-device`` flag: the torch device to run on (CUDA
    unless given)."""
    parser.add_argument("-device", default=None,
                        help="torch device, e.g. cuda or cpu (default cuda)")
