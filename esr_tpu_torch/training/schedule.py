"""LR schedules (counterpart of ``esr_tpu/training/schedule.py``).

The reference recipe steps ``ExponentialLR(gamma)`` every ``change_rate``
iterations, but only while the lr before the step is still >= ``floor``:
decay ``m`` happens iff the lr after ``m - 1`` decays is >= the floor, so
the last value may land just below the floor and then stays.
"""

from __future__ import annotations

import math
from typing import Callable


def exponential_with_floor(
    base_lr: float, gamma: float = 0.95, change_rate: int = 4000, floor: float = 1e-4,
) -> Callable[[int], float]:
    """The gated decay as a plain function of the step (the number of
    updates already made)."""
    if base_lr < floor:
        max_decays = 0
    else:
        max_decays = max(math.floor(math.log(floor / base_lr) / math.log(gamma)) + 1, 0)

    def schedule(step: int) -> float:
        return base_lr * gamma ** min(int(step) // change_rate, max_decays)

    return schedule
