"""What a driver returns for each instance it was given."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Answer:
    """What the program returned for one instance."""
    k: int                 # the instance's index in the pool
    energy: float          # the energy the program reports
    bits: np.ndarray       # its state, one spin per bit (1 = up)
    degeneracy: int
    log2p: float           # the program's log2-probability of the state
    recheck: float | None = None   # the program's own re-check, if any
    exact: bool = True     # the program reports its merge complete

