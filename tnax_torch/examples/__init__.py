"""tnax's example scripts on the port (counterparts of ``examples/``),
each run as a module with tnax's arguments and defaults plus
``-device`` (CUDA unless given)::

    python -m tnax_torch.examples.e01_search_gs -L 128 -ins 1
    python -m tnax_torch.examples.e05_minimal_rmf -device cpu

The instances are read from ``$TNAX_INSTANCES`` in the reference's layout
(:mod:`tnax_torch.examples.common`).
"""
