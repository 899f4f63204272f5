"""Message-delay constants of the cycle-driven simulator (paper §4).

Each network delivery costs a uniformly random delay of MIN_DELAY..MAX_DELAY
cycles; the device engine's delivery wheel has MAX_DELAY + 1 slots. Copied
from `repro.core.simulator` (the host message table is not part of the
port yet).
"""
MIN_DELAY, MAX_DELAY = 1, 10
